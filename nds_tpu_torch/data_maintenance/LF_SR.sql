-- Copied from nds_tpu/data_maintenance/LF_SR.sql, unchanged.
-- LF_SR: refresh-insert store_returns from the returns staging table
-- (role of reference nds/data_maintenance/LF_SR.sql, original SQL).
CREATE TEMP VIEW srv AS
SELECT d_date_sk AS sr_returned_date_sk,
       t_time_sk AS sr_return_time_sk,
       i_item_sk AS sr_item_sk,
       c_customer_sk AS sr_customer_sk,
       c_current_cdemo_sk AS sr_cdemo_sk,
       c_current_hdemo_sk AS sr_hdemo_sk,
       c_current_addr_sk AS sr_addr_sk,
       s_store_sk AS sr_store_sk,
       r_reason_sk AS sr_reason_sk,
       sret_ticket_number AS sr_ticket_number,
       sret_return_qty AS sr_return_quantity,
       sret_return_amt AS sr_return_amt,
       sret_return_tax AS sr_return_tax,
       sret_return_amt + sret_return_tax AS sr_return_amt_inc_tax,
       sret_return_fee AS sr_fee,
       sret_return_ship_cost AS sr_return_ship_cost,
       sret_refunded_cash AS sr_refunded_cash,
       sret_reversed_charge AS sr_reversed_charge,
       sret_store_credit AS sr_store_credit,
       sret_return_amt + sret_return_tax + sret_return_fee
         + sret_return_ship_cost - sret_refunded_cash
         - sret_reversed_charge - sret_store_credit AS sr_net_loss
-- join kinds mirror the reference row-for-row (LF_SR.sql: every lookup
-- LEFT OUTER — failed lookups insert with NULL surrogate keys)
FROM s_store_returns
LEFT JOIN item ON i_item_id = sret_item_id
LEFT JOIN date_dim ON d_date = CAST(sret_return_date AS DATE)
LEFT JOIN time_dim ON t_time = CAST(sret_return_time AS INT)
LEFT JOIN customer ON c_customer_id = sret_customer_id
LEFT JOIN store ON s_store_id = sret_store_id
LEFT JOIN reason ON r_reason_id = sret_reason_id;
INSERT INTO store_returns SELECT * FROM srv;
DROP VIEW srv
