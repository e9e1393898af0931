-- Copied from nds_tpu/data_maintenance/LF_WS.sql, unchanged.
-- LF_WS: refresh-insert web_sales from web-order staging tables
-- (role of reference nds/data_maintenance/LF_WS.sql, original SQL).
CREATE TEMP VIEW wsv AS
SELECT d1.d_date_sk AS ws_sold_date_sk,
       t_time_sk AS ws_sold_time_sk,
       d2.d_date_sk AS ws_ship_date_sk,
       i_item_sk AS ws_item_sk,
       c1.c_customer_sk AS ws_bill_customer_sk,
       c1.c_current_cdemo_sk AS ws_bill_cdemo_sk,
       c1.c_current_hdemo_sk AS ws_bill_hdemo_sk,
       c1.c_current_addr_sk AS ws_bill_addr_sk,
       c2.c_customer_sk AS ws_ship_customer_sk,
       c2.c_current_cdemo_sk AS ws_ship_cdemo_sk,
       c2.c_current_hdemo_sk AS ws_ship_hdemo_sk,
       c2.c_current_addr_sk AS ws_ship_addr_sk,
       wp_web_page_sk AS ws_web_page_sk,
       web_site_sk AS ws_web_site_sk,
       sm_ship_mode_sk AS ws_ship_mode_sk,
       w_warehouse_sk AS ws_warehouse_sk,
       p_promo_sk AS ws_promo_sk,
       word_order_id AS ws_order_number,
       wlin_quantity AS ws_quantity,
       i_wholesale_cost AS ws_wholesale_cost,
       i_current_price AS ws_list_price,
       wlin_sales_price AS ws_sales_price,
       (i_current_price - wlin_sales_price) * wlin_quantity AS ws_ext_discount_amt,
       wlin_sales_price * wlin_quantity AS ws_ext_sales_price,
       i_wholesale_cost * wlin_quantity AS ws_ext_wholesale_cost,
       i_current_price * wlin_quantity AS ws_ext_list_price,
       ROUND(wlin_sales_price * wlin_quantity * 0.08, 2) AS ws_ext_tax,
       wlin_coupon_amt AS ws_coupon_amt,
       wlin_ship_cost * wlin_quantity AS ws_ext_ship_cost,
       wlin_sales_price * wlin_quantity - wlin_coupon_amt AS ws_net_paid,
       ROUND((wlin_sales_price * wlin_quantity - wlin_coupon_amt) * 1.08, 2) AS ws_net_paid_inc_tax,
       wlin_sales_price * wlin_quantity - wlin_coupon_amt
         + wlin_ship_cost * wlin_quantity AS ws_net_paid_inc_ship,
       ROUND((wlin_sales_price * wlin_quantity - wlin_coupon_amt) * 1.08, 2)
         + wlin_ship_cost * wlin_quantity AS ws_net_paid_inc_ship_tax,
       wlin_sales_price * wlin_quantity - wlin_coupon_amt
         - i_wholesale_cost * wlin_quantity AS ws_net_profit
-- join kinds mirror the reference row-for-row (LF_WS.sql: all dimension
-- lookups LEFT OUTER; the SCD tables item/web_page/web_site restrict to
-- the CURRENT record, *_rec_end_date IS NULL, via pre-filtered builds)
FROM s_web_order
JOIN s_web_order_lineitem ON word_order_id = wlin_order_id
LEFT JOIN (SELECT i_item_sk, i_item_id, i_wholesale_cost, i_current_price
           FROM item WHERE i_rec_end_date IS NULL) item
  ON i_item_id = wlin_item_id
LEFT JOIN date_dim d1 ON d1.d_date = CAST(word_order_date AS DATE)
LEFT JOIN date_dim d2 ON d2.d_date = CAST(wlin_ship_date AS DATE)
LEFT JOIN time_dim ON t_time = word_order_time
LEFT JOIN customer c1 ON c1.c_customer_id = word_bill_customer_id
LEFT JOIN customer c2 ON c2.c_customer_id = word_ship_customer_id
LEFT JOIN (SELECT wp_web_page_sk, wp_web_page_id FROM web_page
           WHERE wp_rec_end_date IS NULL) web_page
  ON wp_web_page_id = wlin_web_page_id
LEFT JOIN (SELECT web_site_sk, web_site_id FROM web_site
           WHERE web_rec_end_date IS NULL) web_site
  ON web_site_id = word_web_site_id
LEFT JOIN ship_mode ON sm_ship_mode_id = word_ship_mode_id
LEFT JOIN warehouse ON w_warehouse_id = wlin_warehouse_id
LEFT JOIN promotion ON p_promo_id = wlin_promotion_id;
INSERT INTO web_sales SELECT * FROM wsv;
DROP VIEW wsv
