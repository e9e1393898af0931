-- Copied from nds_tpu/data_maintenance/LF_CR.sql, unchanged.
-- LF_CR: refresh-insert catalog_returns from the returns staging table
-- (role of reference nds/data_maintenance/LF_CR.sql, original SQL).
CREATE TEMP VIEW crv AS
SELECT d_date_sk AS cr_returned_date_sk,
       t_time_sk AS cr_returned_time_sk,
       i_item_sk AS cr_item_sk,
       c1.c_customer_sk AS cr_refunded_customer_sk,
       c1.c_current_cdemo_sk AS cr_refunded_cdemo_sk,
       c1.c_current_hdemo_sk AS cr_refunded_hdemo_sk,
       c1.c_current_addr_sk AS cr_refunded_addr_sk,
       c2.c_customer_sk AS cr_returning_customer_sk,
       c2.c_current_cdemo_sk AS cr_returning_cdemo_sk,
       c2.c_current_hdemo_sk AS cr_returning_hdemo_sk,
       c2.c_current_addr_sk AS cr_returning_addr_sk,
       cc_call_center_sk AS cr_call_center_sk,
       cp_catalog_page_sk AS cr_catalog_page_sk,
       sm_ship_mode_sk AS cr_ship_mode_sk,
       w_warehouse_sk AS cr_warehouse_sk,
       r_reason_sk AS cr_reason_sk,
       cret_order_id AS cr_order_number,
       cret_return_qty AS cr_return_quantity,
       cret_return_amt AS cr_return_amount,
       cret_return_tax AS cr_return_tax,
       cret_return_amt + cret_return_tax AS cr_return_amt_inc_tax,
       cret_return_fee AS cr_fee,
       cret_return_ship_cost AS cr_return_ship_cost,
       cret_refunded_cash AS cr_refunded_cash,
       cret_reversed_charge AS cr_reversed_charge,
       cret_merchant_credit AS cr_store_credit,
       cret_return_amt + cret_return_tax + cret_return_fee
         + cret_return_ship_cost - cret_refunded_cash
         - cret_reversed_charge - cret_merchant_credit AS cr_net_loss
-- join kinds mirror the reference row-for-row (LF_CR.sql: every lookup
-- LEFT OUTER — failed lookups insert with NULL surrogate keys)
FROM s_catalog_returns
LEFT JOIN item ON i_item_id = cret_item_id
LEFT JOIN date_dim ON d_date = CAST(cret_return_date AS DATE)
LEFT JOIN time_dim ON t_time = CAST(cret_return_time AS INT)
LEFT JOIN customer c1 ON c1.c_customer_id = cret_refund_customer_id
LEFT JOIN customer c2 ON c2.c_customer_id = cret_return_customer_id
LEFT JOIN call_center ON cc_call_center_id = cret_call_center_id
LEFT JOIN catalog_page ON cp_catalog_page_id = cret_catalog_page_id
LEFT JOIN ship_mode ON sm_ship_mode_id = cret_shipmode_id
LEFT JOIN warehouse ON w_warehouse_id = cret_warehouse_id
LEFT JOIN reason ON r_reason_id = cret_reason_id;
INSERT INTO catalog_returns SELECT * FROM crv;
DROP VIEW crv
