-- Copied from nds_tpu/data_maintenance/LF_CS.sql, unchanged.
-- LF_CS: refresh-insert catalog_sales from catalog-order staging tables
-- (role of reference nds/data_maintenance/LF_CS.sql, original SQL).
CREATE TEMP VIEW csv AS
SELECT d1.d_date_sk AS cs_sold_date_sk,
       t_time_sk AS cs_sold_time_sk,
       d2.d_date_sk AS cs_ship_date_sk,
       c1.c_customer_sk AS cs_bill_customer_sk,
       c1.c_current_cdemo_sk AS cs_bill_cdemo_sk,
       c1.c_current_hdemo_sk AS cs_bill_hdemo_sk,
       c1.c_current_addr_sk AS cs_bill_addr_sk,
       c2.c_customer_sk AS cs_ship_customer_sk,
       c2.c_current_cdemo_sk AS cs_ship_cdemo_sk,
       c2.c_current_hdemo_sk AS cs_ship_hdemo_sk,
       c2.c_current_addr_sk AS cs_ship_addr_sk,
       cc_call_center_sk AS cs_call_center_sk,
       cp_catalog_page_sk AS cs_catalog_page_sk,
       sm_ship_mode_sk AS cs_ship_mode_sk,
       w_warehouse_sk AS cs_warehouse_sk,
       i_item_sk AS cs_item_sk,
       p_promo_sk AS cs_promo_sk,
       cord_order_id AS cs_order_number,
       clin_quantity AS cs_quantity,
       i_wholesale_cost AS cs_wholesale_cost,
       i_current_price AS cs_list_price,
       clin_sales_price AS cs_sales_price,
       (i_current_price - clin_sales_price) * clin_quantity AS cs_ext_discount_amt,
       clin_sales_price * clin_quantity AS cs_ext_sales_price,
       i_wholesale_cost * clin_quantity AS cs_ext_wholesale_cost,
       i_current_price * clin_quantity AS cs_ext_list_price,
       ROUND(clin_sales_price * clin_quantity * 0.08, 2) AS cs_ext_tax,
       clin_coupon_amt AS cs_coupon_amt,
       clin_ship_cost * clin_quantity AS cs_ext_ship_cost,
       clin_sales_price * clin_quantity - clin_coupon_amt AS cs_net_paid,
       ROUND((clin_sales_price * clin_quantity - clin_coupon_amt) * 1.08, 2) AS cs_net_paid_inc_tax,
       clin_sales_price * clin_quantity - clin_coupon_amt
         + clin_ship_cost * clin_quantity AS cs_net_paid_inc_ship,
       ROUND((clin_sales_price * clin_quantity - clin_coupon_amt) * 1.08, 2)
         + clin_ship_cost * clin_quantity AS cs_net_paid_inc_ship_tax,
       clin_sales_price * clin_quantity - clin_coupon_amt
         - i_wholesale_cost * clin_quantity AS cs_net_profit
-- join kinds mirror the reference row-for-row (LF_CS.sql: all dimension
-- lookups LEFT OUTER; SCD tables item/call_center restrict to the CURRENT
-- record, *_rec_end_date IS NULL, via pre-filtered builds)
FROM s_catalog_order
JOIN s_catalog_order_lineitem ON cord_order_id = clin_order_id
LEFT JOIN (SELECT i_item_sk, i_item_id, i_wholesale_cost, i_current_price
           FROM item WHERE i_rec_end_date IS NULL) item
  ON i_item_id = clin_item_id
LEFT JOIN date_dim d1 ON d1.d_date = CAST(cord_order_date AS DATE)
LEFT JOIN date_dim d2 ON d2.d_date = CAST(clin_ship_date AS DATE)
LEFT JOIN time_dim ON t_time = cord_order_time
LEFT JOIN customer c1 ON c1.c_customer_id = cord_bill_customer_id
LEFT JOIN customer c2 ON c2.c_customer_id = cord_ship_customer_id
LEFT JOIN (SELECT cc_call_center_sk, cc_call_center_id FROM call_center
           WHERE cc_rec_end_date IS NULL) call_center
  ON cc_call_center_id = cord_call_center_id
LEFT JOIN catalog_page ON cp_catalog_number = clin_catalog_number
  AND cp_catalog_page_number = clin_catalog_page_number
LEFT JOIN ship_mode ON sm_ship_mode_id = cord_ship_mode_id
LEFT JOIN warehouse ON w_warehouse_id = clin_warehouse_id
LEFT JOIN promotion ON p_promo_id = clin_promotion_id;
INSERT INTO catalog_sales SELECT * FROM csv;
DROP VIEW csv
